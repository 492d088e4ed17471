// Multi-level pooled linear tap lookup for Hopper (sm_90a).
//
// Replaces the TPU kernel `gather_pyramid_aligned_pm` of the JAX package
// (anystereo_tpu/ops/pallas/lookup_kernel.py, forward body
// `_pyr_align_fwd_kernel`).  Row r of the volume `vol [R, L]` (row-major,
// the layout the volumes already have in memory) has a level-0 position
// x[r].  After clamping x to [-(radius+2)*2^levels, L + (radius+2)*2^levels],
// level lvl samples `taps` consecutive taps at base + k, base = x*2^-lvl -
// radius, from the row avg-pooled by 2^lvl (floor truncation: pooled[j] is
// the mean of vol[r, j*2^lvl : (j+1)*2^lvl] for j < L >> lvl), by linear
// interpolation with zero outside [0, (L >> lvl) - 1].  Output
// `out [R, levels*taps]`, level-major, fp32 math, rounded to fp32 or bf16
// only at the store.
//
// What bounds it: memory.  Each output is ~4 flops over a few loaded values,
// far below the card's ~20 flops per byte, so the least time is the bytes
// moved: of the volume only the entries inside some level's window (about
// (taps+1)*2^(levels-1) consecutive floats a row: the deepest level's window
// covers the shallower ones), x, and the output once.  The design:
//
// - A block of 256 threads owns a tile of consecutive rows; a group of
//   `kLanes` lanes (8, 16 or 32 as the levels deepen) loads 4 rows of it.
// - Loads: the group copies each row's window span, the deepest level's
//   window [2^D*floor(base_D), +(taps+1)*2^D) clipped to [0, L), into shared
//   memory with `cp.async` (every copy of a thread in flight at once,
//   neighbouring lanes on neighbouring floats, no row read twice).  A volume
//   row the positions never touch is never read, which keeps the all-pairs
//   correlation call (L = W/4 = 312) far below a full read of its 37 MB
//   volume.  The loads, x and the output's stores carry evict-first L2
//   hints.  The GRU loop reads the volume again each iteration, but the
//   eval volumes (46 + 37 MB) are larger than the 50 MB L2 together;
//   measured inside the eval forward and the training step (`chip_smoke.py
//   --profile`, against the same source without the hints), the hints take
//   6% and 4% off the kernel's summed time (`PERF.md` §6).
// - Compute: one (row, level) pair a thread.  For the models' 9 taps the
//   taps+1 pooled cells are computed once into registers and each tap is
//   interpolated from them; a cell that fp32 rounding of base + k moved past
//   the span is read from device memory, so the span never has to be exact.
// - Stores: the tile's outputs, `rows x levels*taps` values that lie
//   contiguous in `out`, are staged in shared memory and written as 16-byte
//   vectors.
//
// On the H100 the GEV call (R 239,616, L 48) then takes about 1.4x as long
// as a PyTorch copy of as many bytes as its bound counts, timed the same
// way; its reads come in whole 32-byte sectors, ~112 B a row for the 80 B
// of a window (`PERF.md` §6).

// Numerics match the plain PyTorch version (`gather_pyramid_aligned_ref`)
// operation for operation: tap positions are base + k in fp32, pooling is
// the pairwise mean-of-means of repeated halving, and the interpolation is
// v0*(1-w) + v1*w with explicit round-to-nearest intrinsics so that nvcc
// contracts nothing into an FMA.
//
// Backward (`anystereo_gather_pyramid_aligned_bwd`, replaces
// `_pyr_align_bwd_kernel` of the same file): the transpose of the above in
// `vol`.  Row r of `dvol [R, L]` depends on that row's g[r, :] and x[r]
// only, so there is no race and no atomic.  Per level the taps scatter
// g*(1 - w_k) into their lower pooled cell floor(base + k) and g*w_k into
// the upper one, taps ascending; the cell gradient then spreads over the
// cell's 2^lvl entries, scaled by 2^-lvl, and the levels add up in
// ascending order.  Cells outside [0, (L >> lvl) - 1] are dropped (the
// forward's validity test), so the odd tail past (L >> lvl) << lvl gets
// nothing from that level.  Every entry of dvol is written, zeros included,
// so the wrapper hands in uninitialised memory.  `g` arrives in the
// forward's output type (bf16 on the training path) and is widened to fp32.
//
// What bounds it: bytes (g and x read once, the whole of dvol written
// once); each entry costs a few operations a level.  The design is the
// forward's tile turned around (`BwdGeometry`: 64 rows a block at 2 and 3
// levels, 32 at 4 and 5):
//
// - Loads: the tile's g [rows, levels*taps] and x lie contiguous in memory
//   and are copied once into shared memory as 16-byte vectors.
// - Cells: one thread a (row, level) pair walks the taps in ascending order
//   and adds into `taps + 2` cells from floor(base) on, in registers for
//   the models' 9 taps; the extra cell takes a tap that fp32 rounding of
//   base + k moved one cell up.  The cells and their first index go to
//   shared memory.
// - Stores: the tile's dvol block [rows, L] is contiguous; each thread
//   computes four neighbouring entries from the cells of each level and
//   writes them as one 16-byte vector.  No L2 hint: autograd adds each
//   iteration's dvol into the volume's gradient right after.
//
// The tap positions, weights and the order of every sum (taps ascending,
// lower cell before upper, levels ascending) repeat
// `gather_pyramid_aligned_bwd_ref`, so the two agree exactly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxShared = 227 * 1024;  // a block's most on Hopper

// lanes that share one row of the forward (enough for the deepest window),
// and the rows each group of lanes takes in a tile: several, so that many
// independent loads are in flight
template <int LEVELS>
struct FwdGeometry {
  static constexpr int kLanes = LEVELS <= 2 ? 8 : (LEVELS == 3 ? 16 : 32);
  static constexpr int kGroups = kThreads / kLanes;
  static constexpr int kRowsPerGroup = 4;
  static constexpr int kRows = kGroups * kRowsPerGroup;  // rows a block owns
  static constexpr int kWidth = 1 << (LEVELS - 1);
};

// rows a block of the backward owns: the forward's tile, at most 64 rows,
// so that the training correlation's 6,400 rows make 100 blocks, not 50
template <int LEVELS>
struct BwdGeometry {
  static constexpr int kRows = FwdGeometry<LEVELS>::kRows < 64 ? FwdGeometry<LEVELS>::kRows : 64;
};

// Mean of `width` consecutive values at p by pairwise means of means, the
// same rounding as halving the row lvl times.  p is shared or device memory.
template <int MAXW>
__device__ __forceinline__ float pool(const float* p, int width) {
  float buf[MAXW];
#pragma unroll
  for (int m = 0; m < MAXW; ++m) buf[m] = (m < width) ? p[m] : 0.0f;
#pragma unroll
  for (int s = 1; s < MAXW; s <<= 1) {
#pragma unroll
    for (int m = 0; m + s < MAXW; m += 2 * s) {
      if (2 * s <= width) buf[m] = __fmul_rn(__fadd_rn(buf[m], buf[m + s]), 0.5f);
    }
  }
  return buf[0];
}

// Pooled cell j of a row at width 2^lvl, zero outside [0, n_lvl): from the
// row's span in shared memory (`span` holds entries [origin, origin + slot))
// where the cell lies inside it, else from the row in device memory.
template <int MAXW>
__device__ __forceinline__ float cell(const float* __restrict__ row,
                                      const float* span, int origin, int slot,
                                      int j, int width, int n_lvl) {
  if (j < 0 || j >= n_lvl) return 0.0f;
  const int e = j * width;
  const int i = e - origin;
  if (i >= 0 && i + width <= slot) return pool<MAXW>(span + i, width);
  return pool<MAXW>(row + e, width);
}

__device__ __forceinline__ void convert(float* p, float v) { *p = v; }
__device__ __forceinline__ void convert(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Shared memory of the forward: the spans [kRows][slot] fp32, each row's
// clamped x and span origin, then the staged outputs [kRows][levels*taps].
__host__ __device__ __forceinline__ int span_bytes(int rows, int slot) {
  return (rows * (slot + 2) * 4 + 15) & ~15;
}

// The taps of one (row, level) pair, in order.  TAPS > 0 (a count known at
// compile time) pools the taps+1 cells from floor(base) once, into
// registers, and interpolates each tap from them; a tap that fp32 rounding
// of base + k moved to the next cell reads its own cells.  TAPS == 0 walks
// the taps with the count `taps`, reusing the previous tap's upper cell.
template <int TAPS, int MAXW, typename OutT>
__device__ __forceinline__ void level_taps(const float* __restrict__ row, const float* span,
                                           int org, int slot, float base, int width,
                                           int n_lvl, int taps, OutT* o) {
  if constexpr (TAPS > 0) {
    const int c0 = (int)floorf(base);  // base + 0 is base: tap 0's lower cell
    float cells[TAPS + 1];
#pragma unroll
    for (int c = 0; c <= TAPS; ++c) cells[c] = cell<MAXW>(row, span, org, slot, c0 + c, width, n_lvl);
#pragma unroll
    for (int k = 0; k < TAPS; ++k) {
      const float pos = __fadd_rn(base, (float)k);
      const float f0 = floorf(pos);
      const float w1 = __fsub_rn(pos, f0);
      const int i0 = (int)f0;
      float v0 = cells[k], v1 = cells[k + 1];
      if (i0 != c0 + k) {
        v0 = cell<MAXW>(row, span, org, slot, i0, width, n_lvl);
        v1 = cell<MAXW>(row, span, org, slot, i0 + 1, width, n_lvl);
      }
      convert(o + k, __fadd_rn(__fmul_rn(v0, __fsub_rn(1.0f, w1)), __fmul_rn(v1, w1)));
    }
  } else {
    int cached_i = INT_MIN;
    float cached_v = 0.0f;
    for (int k = 0; k < taps; ++k) {
      const float pos = __fadd_rn(base, (float)k);
      const float f0 = floorf(pos);
      const float w1 = __fsub_rn(pos, f0);
      const int i0 = (int)f0;
      const float v0 = (i0 == cached_i) ? cached_v
                                        : cell<MAXW>(row, span, org, slot, i0, width, n_lvl);
      const float v1 = cell<MAXW>(row, span, org, slot, i0 + 1, width, n_lvl);
      cached_i = i0 + 1;
      cached_v = v1;
      convert(o + k, __fadd_rn(__fmul_rn(v0, __fsub_rn(1.0f, w1)), __fmul_rn(v1, w1)));
    }
  }
}

// Loads: row grp + r * kGroups of the tile is group grp's r-th row, so
// neighbouring groups hold neighbouring rows.  Compute: one (row, level)
// pair a thread (`level_taps`).
template <typename OutT, int LEVELS, int TAPS>
__global__ void __launch_bounds__(kThreads)
pyr_aligned_fwd(const float* __restrict__ vol, const float* __restrict__ x,
                OutT* __restrict__ out, int64_t rows, int length, int taps,
                int slot, float lo, float hi) {
  using G = FwdGeometry<LEVELS>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* spans = reinterpret_cast<float*>(smem);
  float* xs = spans + G::kRows * slot;
  int* origins = reinterpret_cast<int*>(xs + G::kRows);
  OutT* stage = reinterpret_cast<OutT*>(smem + span_bytes(G::kRows, slot));
  const int lt = LEVELS * taps;
  const int64_t row0 = (int64_t)blockIdx.x * G::kRows;
  const int64_t left = rows - row0;
  const int nrows = left < G::kRows ? (int)left : G::kRows;
  const int grp = threadIdx.x / G::kLanes;
  const int lane = threadIdx.x % G::kLanes;
  const int radius = (taps - 1) / 2;
  const uint64_t policy = evict_first();
  int origin[G::kRowsPerGroup];
#pragma unroll
  for (int r = 0; r < G::kRowsPerGroup; ++r) {
    const int lr = grp + r * G::kGroups;
    const float xc = lr < nrows ? fminf(fmaxf(__ldcs(x + row0 + lr), lo), hi) : 0.0f;
    // the deepest level's window start; the power-of-two scale is exact
    const float base = __fsub_rn(__fmul_rn(xc, 1.0f / (float)G::kWidth), (float)radius);
    origin[r] = (int)floorf(base) * G::kWidth;
    if (lane == 0 && lr < nrows) xs[lr] = xc, origins[lr] = origin[r];
  }
#pragma unroll
  for (int r = 0; r < G::kRowsPerGroup; ++r) {
    const int lr = grp + r * G::kGroups;
    if (lr >= nrows) continue;
    const float* row = vol + (row0 + lr) * length;
    for (int i = lane; i < slot; i += G::kLanes) {
      const int e = origin[r] + i;
      if (e >= 0 && e < length) copy_async4(spans + lr * slot + i, row + e, policy);
    }
  }
  copy_async_wait();
  __syncthreads();
  for (int item = threadIdx.x; item < nrows * LEVELS; item += kThreads) {
    const int lr = item / LEVELS;
    const int lvl = item - lr * LEVELS;
    const int width = 1 << lvl;
    const int n_lvl = length >> lvl;
    const float* row = vol + (row0 + lr) * length;
    const float* span = spans + lr * slot;
    const int org = origins[lr];
    // the scale is a power of two, so the product is exact
    const float base = __fsub_rn(__fmul_rn(xs[lr], 1.0f / (float)width), (float)radius);
    level_taps<TAPS, G::kWidth>(row, span, org, slot, base, width, n_lvl, taps,
                                stage + lr * lt + lvl * taps);
  }
  __syncthreads();
  // the tile's outputs are contiguous in `out`: 16-byte stores, then the tail
  const int n = nrows * lt;
  OutT* dst = out + row0 * lt;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n16 = (int)((n * sizeof(OutT)) >> 4);
    for (int i = threadIdx.x; i < n16; i += kThreads)
      __stcs(reinterpret_cast<uint4*>(dst) + i, reinterpret_cast<const uint4*>(stage)[i]);
    done = (int)((n16 << 4) / sizeof(OutT));
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads) dst[i] = stage[i];
}

template <typename OutT, int LEVELS>
int launch_fwd(const float* vol, const float* x, OutT* out, int64_t rows,
               int length, int taps, float lo, float hi, cudaStream_t s) {
  using G = FwdGeometry<LEVELS>;
  const int slot = (taps + 1) * G::kWidth;
  const int shared = span_bytes(G::kRows, slot) + G::kRows * LEVELS * taps * (int)sizeof(OutT);
  if (shared > kMaxShared) return (int)cudaErrorInvalidValue;
  // the models' 9 taps (radius 4) take the unrolled path
  auto kernel = taps == 9 ? pyr_aligned_fwd<OutT, LEVELS, 9> : pyr_aligned_fwd<OutT, LEVELS, 0>;
  if (shared > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((rows + G::kRows - 1) / G::kRows);
  kernel<<<blocks, kThreads, shared, s>>>(vol, x, out, rows, length, taps, slot, lo, hi);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_fwd_levels(const float* vol, const float* x, OutT* out, int64_t rows,
                      int length, int taps, int levels, float lo, float hi,
                      cudaStream_t s) {
  switch (levels) {
    case 1: return launch_fwd<OutT, 1>(vol, x, out, rows, length, taps, lo, hi, s);
    case 2: return launch_fwd<OutT, 2>(vol, x, out, rows, length, taps, lo, hi, s);
    case 3: return launch_fwd<OutT, 3>(vol, x, out, rows, length, taps, lo, hi, s);
    case 4: return launch_fwd<OutT, 4>(vol, x, out, rows, length, taps, lo, hi, s);
    case 5: return launch_fwd<OutT, 5>(vol, x, out, rows, length, taps, lo, hi, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// n values of T from device to shared memory (`dst` 16-byte aligned), as
// 16-byte vectors where `src` is aligned to them, by all the block's threads
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n16 = (int)((n * sizeof(T)) >> 4);
    for (int i = threadIdx.x; i < n16; i += kThreads)
      reinterpret_cast<uint4*>(dst)[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
    done = (int)((n16 << 4) / sizeof(T));
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// The cell gradients of one (row, level) pair: cells[c] for pooled cell
// floor(base) + c, c < taps + 2, the taps added in ascending order, lower
// cell before upper.  Tap k's lower cell is floor(base) + k, or + k + 1 where
// fp32 rounding of base + k reached the next integer.  TAPS > 0 (a count
// known at compile time) adds in registers; TAPS == 0 adds in `cells`.
template <int TAPS, typename GT>
__device__ __forceinline__ void level_cells(const GT* gl, float base, int c0, int taps,
                                            float* cells) {
  if constexpr (TAPS > 0) {
    float acc[TAPS + 2];
#pragma unroll
    for (int c = 0; c < TAPS + 2; ++c) acc[c] = 0.0f;
#pragma unroll
    for (int k = 0; k < TAPS; ++k) {
      const float pos = __fadd_rn(base, (float)k);
      const float f0 = floorf(pos);
      const float w1 = __fsub_rn(pos, f0);
      const float gk = to_f32(gl[k]);
      const float lower = __fmul_rn(gk, __fsub_rn(1.0f, w1));
      const float upper = __fmul_rn(gk, w1);
      if ((int)f0 == c0 + k) {
        acc[k] = __fadd_rn(acc[k], lower);
        acc[k + 1] = __fadd_rn(acc[k + 1], upper);
      } else {
        acc[k + 1] = __fadd_rn(acc[k + 1], lower);
        acc[k + 2] = __fadd_rn(acc[k + 2], upper);
      }
    }
#pragma unroll
    for (int c = 0; c < TAPS + 2; ++c) cells[c] = acc[c];
  } else {
    for (int c = 0; c < taps + 2; ++c) cells[c] = 0.0f;
    for (int k = 0; k < taps; ++k) {
      const float pos = __fadd_rn(base, (float)k);
      const float f0 = floorf(pos);
      const float w1 = __fsub_rn(pos, f0);
      const float gk = to_f32(gl[k]);
      const int i = (int)f0 - c0;  // k or k + 1
      cells[i] = __fadd_rn(cells[i], __fmul_rn(gk, __fsub_rn(1.0f, w1)));
      cells[i + 1] = __fadd_rn(cells[i + 1], __fmul_rn(gk, w1));
    }
  }
}

// Shared memory of the backward: the cells [rows*levels][taps+2] fp32, their
// first indices [rows*levels], x [rows], then g [rows][levels*taps] from a
// 16-byte boundary.
__host__ __device__ __forceinline__ int bwd_g_offset(int rows, int levels, int taps) {
  return (rows * levels * (taps + 3) * 4 + rows * 4 + 15) & ~15;
}

// dvol[r, j] of tile row lr from the cells: the levels in ascending order,
// each adding its cell's gradient scaled by 2^-lvl where that cell is in
// [0, L >> lvl) and inside the pair's `ncell` cells.
template <int LEVELS>
__device__ __forceinline__ float entry(const float* cells, const int* firsts, int lr, int j,
                                       int length, int ncell) {
  float acc = 0.0f;
#pragma unroll
  for (int lvl = 0; lvl < LEVELS; ++lvl) {
    const int c = j >> lvl;
    const int pair = lr * LEVELS + lvl;
    const int i = c - firsts[pair];
    if (c < (length >> lvl) && i >= 0 && i < ncell)
      acc = __fadd_rn(acc, __fmul_rn(cells[pair * ncell + i], 1.0f / (float)(1 << lvl)));
  }
  return acc;
}

template <typename GT, int LEVELS, int TAPS>
__global__ void __launch_bounds__(kThreads)
pyr_aligned_bwd(const float* __restrict__ x, const GT* __restrict__ g,
                float* __restrict__ dvol, int64_t rows, int length, int taps,
                float lo, float hi) {
  using G = BwdGeometry<LEVELS>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ncell = taps + 2;
  const int lt = LEVELS * taps;
  float* cells = reinterpret_cast<float*>(smem);
  int* firsts = reinterpret_cast<int*>(cells + G::kRows * LEVELS * ncell);
  float* xs = reinterpret_cast<float*>(firsts + G::kRows * LEVELS);
  GT* gs = reinterpret_cast<GT*>(smem + bwd_g_offset(G::kRows, LEVELS, taps));
  const int64_t row0 = (int64_t)blockIdx.x * G::kRows;
  const int64_t left = rows - row0;
  const int nrows = left < G::kRows ? (int)left : G::kRows;
  load_tile(gs, g + row0 * lt, nrows * lt);
  load_tile(xs, x + row0, nrows);
  __syncthreads();
  const int radius = (taps - 1) / 2;
  for (int pair = threadIdx.x; pair < nrows * LEVELS; pair += kThreads) {
    const int lr = pair / LEVELS;
    const int lvl = pair - lr * LEVELS;
    const float xc = fminf(fmaxf(xs[lr], lo), hi);
    // the scale is a power of two, so the product is exact
    const float base = __fsub_rn(__fmul_rn(xc, 1.0f / (float)(1 << lvl)), (float)radius);
    const int c0 = (int)floorf(base);
    level_cells<TAPS>(gs + lr * lt + lvl * taps, base, c0, taps, cells + pair * ncell);
    firsts[pair] = c0;
  }
  __syncthreads();
  // the tile's dvol block is contiguous and starts on a 16-byte boundary
  // (dvol does, and a tile is a multiple of 4 rows): 16-byte vectors of four
  // neighbouring entries, then the tail
  const int n = nrows * length;
  float* dst = dvol + row0 * length;
  const int nvec = n / 4;
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
    const int i = 4 * v;
    int lr = i / length;
    int j = i - lr * length;
    float e[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      e[m] = entry<LEVELS>(cells, firsts, lr, j, length, ncell);
      if (++j == length) j = 0, ++lr;
    }
    reinterpret_cast<float4*>(dst + i)[0] = make_float4(e[0], e[1], e[2], e[3]);
  }
  for (int i = 4 * nvec + threadIdx.x; i < n; i += kThreads) {
    const int lr = i / length;
    dst[i] = entry<LEVELS>(cells, firsts, lr, i - lr * length, length, ncell);
  }
}

template <typename GT, int LEVELS>
int launch_bwd(const float* x, const GT* g, float* dvol, int64_t rows, int length,
               int taps, float lo, float hi, cudaStream_t s) {
  using G = BwdGeometry<LEVELS>;
  const int shared = bwd_g_offset(G::kRows, LEVELS, taps) + G::kRows * LEVELS * taps * (int)sizeof(GT);
  if (shared > kMaxShared) return (int)cudaErrorInvalidValue;
  // the models' 9 taps (radius 4) add in registers
  auto kernel = taps == 9 ? pyr_aligned_bwd<GT, LEVELS, 9> : pyr_aligned_bwd<GT, LEVELS, 0>;
  if (shared > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((rows + G::kRows - 1) / G::kRows);
  kernel<<<blocks, kThreads, shared, s>>>(x, g, dvol, rows, length, taps, lo, hi);
  return (int)cudaGetLastError();
}

template <typename GT>
int launch_bwd_levels(const float* x, const GT* g, float* dvol, int64_t rows, int length,
                      int taps, int levels, float lo, float hi, cudaStream_t s) {
  switch (levels) {
    case 1: return launch_bwd<GT, 1>(x, g, dvol, rows, length, taps, lo, hi, s);
    case 2: return launch_bwd<GT, 2>(x, g, dvol, rows, length, taps, lo, hi, s);
    case 3: return launch_bwd<GT, 3>(x, g, dvol, rows, length, taps, lo, hi, s);
    case 4: return launch_bwd<GT, 4>(x, g, dvol, rows, length, taps, lo, hi, s);
    case 5: return launch_bwd<GT, 5>(x, g, dvol, rows, length, taps, lo, hi, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// vol [rows, length] fp32, x [rows] fp32, out [rows, levels*taps] fp32
// (out_bf16 == 0) or bf16.  Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for levels outside [1, 5] or a tile that does not
// fit in 227 KB of shared memory.
extern "C" int anystereo_gather_pyramid_aligned(const void* vol, const void* x,
                                                void* out, long long rows,
                                                int length, int taps, int levels,
                                                int out_bf16, void* stream) {
  const int radius = (taps - 1) / 2;
  const float slack = (float)((radius + 2) * (1 << levels));
  const float lo = -slack;
  const float hi = (float)length + slack;
  if (rows == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (out_bf16) {
    return launch_fwd_levels<__nv_bfloat16>((const float*)vol, (const float*)x,
                                            (__nv_bfloat16*)out, rows, length, taps,
                                            levels, lo, hi, s);
  }
  return launch_fwd_levels<float>((const float*)vol, (const float*)x, (float*)out,
                                  rows, length, taps, levels, lo, hi, s);
}

// x [rows] fp32, g [rows, levels*taps] fp32 (g_bf16 == 0) or bf16, dvol
// [rows, length] fp32 on a 16-byte boundary, every entry written.  Launches
// on `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue for a
// misaligned dvol, levels outside [1, 5] or a tile that does not fit in
// 227 KB of shared memory.
extern "C" int anystereo_gather_pyramid_aligned_bwd(const void* x, const void* g,
                                                    void* dvol, long long rows,
                                                    int length, int taps,
                                                    int levels, int g_bf16,
                                                    void* stream) {
  const int radius = (taps - 1) / 2;
  const float slack = (float)((radius + 2) * (1 << levels));
  const float lo = -slack;
  const float hi = (float)length + slack;
  if ((reinterpret_cast<uintptr_t>(dvol) & 15) != 0) return (int)cudaErrorInvalidValue;
  if (rows == 0 || length == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (g_bf16) {
    return launch_bwd_levels<__nv_bfloat16>((const float*)x, (const __nv_bfloat16*)g,
                                            (float*)dvol, rows, length, taps, levels, lo,
                                            hi, s);
  }
  return launch_bwd_levels<float>((const float*)x, (const float*)g, (float*)dvol, rows,
                                  length, taps, levels, lo, hi, s);
}
