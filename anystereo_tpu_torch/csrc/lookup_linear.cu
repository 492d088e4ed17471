// Single-level linear tap lookups on row-major volumes, for Hopper (sm_90a):
// arbitrary positions per tap, and a window of consecutive taps from one
// start per row; forward and backward of each.
//
// Replaces the TPU kernels of anystereo_tpu/ops/pallas/lookup_kernel.py:
//   `gather_rows_linear`   vol [R, L], pos [R, K]  -> out [R, K]
//                          (bodies `_fwd_kernel`, `_bwd_kernel`)
//   `gather_window_linear` vol [R, L], base [R], K -> out [R, K]
//                          (bodies `_win_fwd_kernel`, `_win_bwd_kernel`)
//
// What they compute.  Rows: tap k of row r sits at p = pos[r, k];
// i0 = floor(p), w = p - i0, out = vol[r, i0]*(1 - w) + vol[r, i0+1]*w, where
// an entry outside [0, L) counts as zero (each neighbour on its own, so
// i0 = -1 keeps its upper half and i0 = L-1 its lower).  The backward is the
// transpose in the volume: dvol[r, l] = sum over k of g[r, k]*(1 - w_k) where
// i0_k == l, plus g[r, k]*w_k where i0_k + 1 == l; taps that share an entry
// sum.  Window: tap k of row r sits at base[r] + k, so i0 = floor(base) and
// f = base - i0 are shared by the row's taps: out[r, k] = (1 - f)*vol[r, i0+k]
// + f*vol[r, i0+k+1]; backward dvol[r, i0+j] = (1 - f)*g[r, j] + f*g[r, j-1]
// for j = 0..K (terms with a tap index outside [0, K) absent), one
// coefficient an entry.  Positions get no gradient.  Everything is fp32.
//
// What bounds them: memory.  A tap is two loads, three products and sums.  The
// TPU bodies form every tap as a masked sum over all 128-padded lanes of the
// row, in tiles of 256 rows, because a lane cannot index; here only the
// entries some tap needs are read.
//   - rows forward: a thread per output element, k fastest, so the loads of
//     pos and the stores coalesce; the rows' loads stay inside one row (a
//     few KB, served by L1/L2);
//   - window forward (B7, the "levels" flavor's lookup): a thread per
//     output element, as the rows forward, paid a 64-bit division, a reload
//     of base[r] and its floor for each of a row's taps, and loaded each
//     window entry twice: at the GEV volume (R 239,616, L 48) its own work
//     took 3.4x its bound of bytes on the H100, bound by its instructions.
//     So each warp owns a tile of consecutive rows and works alone, with no
//     barrier across the block, so that the warps of an SM overlap one
//     tile's loads with another's stores; a tile is 32 rows, or 16 where
//     that leaves too few warps to fill the card (`window_tile`).  A lane a
//     row forms i0 and f once; the tile's windows, taps+1 entries a row,
//     are copied once into the warp's shared memory by cp.async,
//     neighbouring lanes on neighbouring entries of a row (zeros outside
//     [0, L)), all of a lane's copies in flight at once and with an
//     evict-first L2 hint, as B4's (the GRU loop's pooled levels are larger
//     than L2); then the tile's taps, tile*taps floats that lie contiguous
//     in `out`, are formed four at a time from shared memory and written as
//     16-byte vectors.  Index arithmetic inside the tile is 32-bit, with the
//     divisor a constant for the models' 9 taps.  The GEV call is then bound
//     by bytes (a 40-byte window touches two or three 32-byte sectors of its
//     row).  With fewer rows than 16-row tiles need to fill the card (the
//     correlation calls, 29,952 rows and fewer) the launch and two dependent
//     loads bound the call, and a thread a tap (`window_linear_fwd_taps`,
//     32-bit indices) keeps each thread's path the shortest: on the H100 the
//     staged tiles were a little slower there.  Windows too wide to stage
//     (taps + 1 > kWinStaged, wider than any model's) take it too;
//   - window backward: a thread per entry of dvol; its slot j = l - i0 names
//     its one coefficient; no atomics, every entry written;
//   - rows backward: taps collide inside a row (many k land on one l), and
//     the sum must have a fixed order to equal the plain version.  A block
//     takes 256 entries of one row; the row's taps are staged in shared
//     memory a chunk at a time as (i0, g*(1-w), g*w), and every thread walks
//     them in ascending k, adding the half that lands on its entry.  That is
//     K*L comparisons a row instead of 2K atomics: exact, deterministic, every
//     entry written, and still far below a millisecond at 375 x 1242 x 1242.
//
// Numerics: every operation is an explicit round-to-nearest intrinsic in the
// order of the plain PyTorch versions (`ops/kernels/lookup_linear.py`), so
// nvcc contracts nothing into an FMA and kernel and plain version agree bit
// for bit.  floor(p) is clamped in float to [-2, L] (rows) or [-(K+1), L]
// (window) before the conversion to int: that moves only taps and windows
// with no live entry and keeps the index finite for positions like 3e9.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTapChunk = 1024;  // taps of a row staged at a time (12 KB)
constexpr int kWinWarps = 4;        // warps a block of the window forward holds
constexpr int kWinWarpsPerSM = 16;  // warps a tile height must give each SM
constexpr int kWinStaged = 94;      // the widest window (taps + 1) it stages: 48 KB a block

// 4-byte words of shared memory a warp of the window forward takes: f and
// i0 of its `tile` rows, then their windows of `span` entries.
__host__ __device__ constexpr int win_words(int tile, int span) { return tile * (2 + span); }

__device__ __forceinline__ float entry_or_zero(const float* __restrict__ row, int i,
                                               int length) {
  return (i >= 0 && i < length) ? __ldg(row + i) : 0.0f;
}

// lower*(1 - w) + upper*w, in the plain version's order
__device__ __forceinline__ float lerp_rn(float lower, float upper, float w) {
  return __fadd_rn(__fmul_rn(lower, __fsub_rn(1.0f, w)), __fmul_rn(upper, w));
}

// ---- arbitrary positions ----

__global__ void __launch_bounds__(kThreads)
rows_linear_fwd(const float* __restrict__ vol, const float* __restrict__ pos,
                float* __restrict__ out, int64_t rows, int length, int taps) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * taps) return;
  const int64_t r = t / taps;
  const float p = __ldg(pos + t);
  const float f0 = floorf(p);
  const float w = __fsub_rn(p, f0);
  const int i0 = (int)fminf(fmaxf(f0, -2.0f), (float)length);
  const float* row = vol + r * length;
  out[t] = lerp_rn(entry_or_zero(row, i0, length), entry_or_zero(row, i0 + 1, length), w);
}

// grid (rows, ceil(length / kThreads)): thread -> entry l of row blockIdx.x
__global__ void __launch_bounds__(kThreads)
rows_linear_bwd(const float* __restrict__ pos, const float* __restrict__ g,
                float* __restrict__ dvol, int length, int taps) {
  __shared__ int s_i0[kTapChunk];
  __shared__ float s_lower[kTapChunk];
  __shared__ float s_upper[kTapChunk];
  const int64_t r = blockIdx.x;
  const int l = blockIdx.y * kThreads + threadIdx.x;
  const float* prow = pos + r * taps;
  const float* grow = g + r * taps;
  float acc = 0.0f;
  for (int k0 = 0; k0 < taps; k0 += kTapChunk) {
    const int n = min(kTapChunk, taps - k0);
    __syncthreads();  // the previous chunk has been read
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float p = __ldg(prow + k0 + i);
      const float gv = __ldg(grow + k0 + i);
      const float f0 = floorf(p);
      const float w = __fsub_rn(p, f0);
      s_i0[i] = (int)fminf(fmaxf(f0, -2.0f), (float)length);
      s_lower[i] = __fmul_rn(gv, __fsub_rn(1.0f, w));
      s_upper[i] = __fmul_rn(gv, w);
    }
    __syncthreads();
    if (l < length) {
      for (int i = 0; i < n; ++i) {  // ascending k: the plain version's order
        const int d = l - s_i0[i];
        if (d == 0) acc = __fadd_rn(acc, s_lower[i]);
        else if (d == 1) acc = __fadd_rn(acc, s_upper[i]);
      }
    }
  }
  if (l < length) dvol[r * length + l] = acc;
}

// ---- a window of consecutive taps from one start per row ----

__device__ __forceinline__ void window_start(float base, int length, int taps, int& i0,
                                             float& f) {
  const float f0 = floorf(base);
  f = __fsub_rn(base, f0);
  i0 = (int)fminf(fmaxf(f0, -(float)(taps + 1)), (float)length);
}

// Each warp owns a tile of `tile` consecutive rows (32 or 16), stages
// their windows in its shared memory [tile][taps + 1] and works alone (no
// block barrier, so the warps of an SM overlap their loads and stores):
// TAPS > 0 is the count known at compile time, 0 takes `taps_rt`.
template <int TAPS>
__global__ void __launch_bounds__(32 * kWinWarps)
window_linear_fwd(const float* __restrict__ vol, const float* __restrict__ base,
                  float* __restrict__ out, int64_t rows, int length, int taps_rt, int tile) {
  extern __shared__ __align__(16) float smem[];
  const int taps = TAPS > 0 ? TAPS : taps_rt;
  const int span = taps + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* fs = smem + warp * win_words(tile, span);  // [tile]
  int* starts = reinterpret_cast<int*>(fs + tile);  // [tile]
  float* win = fs + 2 * tile;                       // [tile][span]
  const int64_t r0 = ((int64_t)blockIdx.x * kWinWarps + warp) * tile;
  if (r0 >= rows) return;
  const int nrows = rows - r0 < tile ? (int)(rows - r0) : tile;
  const float* vol0 = vol + r0 * length;  // the tile's rows: 32 * length < 2^31
  if (lane < nrows) {
    int i0;
    float f;
    window_start(__ldg(base + r0 + lane), length, taps, i0, f);
    starts[lane] = i0;
    fs[lane] = f;
  }
  __syncwarp();
  // asynchronous copies: no load waits on the store of the one before
  const uint64_t policy = evict_first();
  for (int i = lane; i < nrows * span; i += 32) {
    const int row = i / span;
    const int j = starts[row] + (i - row * span);
    if (j >= 0 && j < length)
      copy_async4(win + i, vol0 + row * length + j, policy);
    else
      win[i] = 0.0f;
  }
  copy_async_wait();
  __syncwarp();
  // tap e of the tile: (1 - f)*s_k + f*s_{k+1} of row e / taps, k = e % taps
  auto tap = [&](int e) {
    const int row = e / taps;
    const int k = e - row * taps;
    const float f = fs[row];
    const float* s = win + row * span + k;
    return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, f), s[0]), __fmul_rn(f, s[1]));
  };
  // the tile's taps are contiguous in `out` (and start on a 16-byte boundary
  // where `out` does: r0 is a multiple of 16)
  const int total = nrows * taps;
  float* dst = out + r0 * taps;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    for (int i = lane; i < total / 4; i += 32)
      reinterpret_cast<float4*>(dst)[i] = make_float4(tap(4 * i), tap(4 * i + 1), tap(4 * i + 2),
                                                      tap(4 * i + 3));
    done = total & ~3;
  }
  for (int e = done + lane; e < total; e += 32) dst[e] = tap(e);
}

// Few rows (a few thousand), or windows too wide to stage: a thread a tap,
// 32-bit indices (rows * taps below 2^31 - kThreads).  There the launch and
// two dependent loads bound the call, and a thread's path is shortest when
// each forms one tap.  (Its name holds `window_linear_fwd`: a profiler sum
// of B7 by name takes both.)
template <int TAPS>
__global__ void __launch_bounds__(kThreads)
window_linear_fwd_taps(const float* __restrict__ vol, const float* __restrict__ base,
                   float* __restrict__ out, int rows, int length, int taps_rt) {
  const int taps = TAPS > 0 ? TAPS : taps_rt;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= rows * taps) return;
  const int r = e / taps;
  const int k = e - r * taps;
  int i0;
  float f;
  window_start(__ldg(base + r), length, taps, i0, f);
  const float* row = vol + (int64_t)r * length;
  out[e] = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, f), entry_or_zero(row, i0 + k, length)),
                     __fmul_rn(f, entry_or_zero(row, i0 + k + 1, length)));
}

// Rows of a warp's tile in the window forward: 32, or 16 where 32 leaves
// the card's `sms` SMs fewer than kWinWarpsPerSM warps each; 0 where 16
// does too, or where the window is too wide to stage (a thread a tap then,
// `window_linear_fwd_taps`).
inline int window_tile(int64_t rows, int taps, int sms) {
  if (taps + 1 > kWinStaged) return 0;
  for (int tile = 32; tile >= 16; tile /= 2)
    if ((rows + tile - 1) / tile >= (int64_t)kWinWarpsPerSM * sms) return tile;
  return 0;
}

__global__ void __launch_bounds__(kThreads)
window_linear_bwd(const float* __restrict__ base, const float* __restrict__ g,
                  float* __restrict__ dvol, int64_t rows, int length, int taps) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * length) return;
  const int64_t r = t / length;
  const int l = (int)(t - r * length);
  int i0;
  float f;
  window_start(__ldg(base + r), length, taps, i0, f);
  const int j = l - i0;
  float c = 0.0f;
  if (j >= 0 && j <= taps) {
    const float* grow = g + r * taps;
    if (j < taps) c = __fmul_rn(__fsub_rn(1.0f, f), __ldg(grow + j));
    if (j >= 1) c = __fadd_rn(c, __fmul_rn(f, __ldg(grow + j - 1)));
  }
  dvol[t] = c;
}

inline unsigned blocks_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// All operands fp32 and contiguous; every kernel launches on `stream` and the
// function returns cudaGetLastError().

// vol [rows, length], pos [rows, taps] -> out [rows, taps]
extern "C" int anystereo_gather_rows_linear(const void* vol, const void* pos, void* out,
                                            long long rows, int length, int taps,
                                            void* stream) {
  if (length < 1 || taps < 1 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  rows_linear_fwd<<<blocks_for((int64_t)rows * taps), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)vol, (const float*)pos, (float*)out, rows, length, taps);
  return (int)cudaGetLastError();
}

// pos [rows, taps], g [rows, taps] -> dvol [rows, length], every entry written
extern "C" int anystereo_gather_rows_linear_bwd(const void* pos, const void* g, void* dvol,
                                                long long rows, int length, int taps,
                                                void* stream) {
  if (length < 1 || taps < 1 || rows < 0 || rows > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)rows, blocks_for(length));
  rows_linear_bwd<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)g, (float*)dvol, length, taps);
  return (int)cudaGetLastError();
}

// vol [rows, length], base [rows] -> out [rows, taps]
extern "C" int anystereo_gather_window_linear(const void* vol, const void* base, void* out,
                                              long long rows, int length, int taps,
                                              void* stream) {
  // a tile's rows, and a thread a tap's taps, are indexed in 32 bits
  if (length < 1 || taps < 1 || rows < 0 || length > INT_MAX / 32 || taps > INT_MAX / 32 - 1)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int tile = window_tile(rows, taps, sms);
  if (tile == 0) {
    if (rows * taps > INT_MAX - kThreads) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((rows * taps + kThreads - 1) / kThreads);
    auto kernel = taps == 9 ? window_linear_fwd_taps<9> : window_linear_fwd_taps<0>;
    kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)vol, (const float*)base, (float*)out, (int)rows, length, taps);
    return (int)cudaGetLastError();
  }
  const size_t shared = sizeof(float) * kWinWarps * win_words(tile, taps + 1);
  const int64_t rows_per_block = (int64_t)kWinWarps * tile;
  const unsigned blocks = (unsigned)((rows + rows_per_block - 1) / rows_per_block);
  auto kernel = taps == 9 ? window_linear_fwd<9> : window_linear_fwd<0>;
  kernel<<<blocks, 32 * kWinWarps, shared, (cudaStream_t)stream>>>(
      (const float*)vol, (const float*)base, (float*)out, rows, length, taps, tile);
  return (int)cudaGetLastError();
}

// base [rows], g [rows, taps] -> dvol [rows, length], every entry written
extern "C" int anystereo_gather_window_linear_bwd(const void* base, const void* g, void* dvol,
                                                  long long rows, int length, int taps,
                                                  void* stream) {
  if (length < 1 || taps < 1 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  window_linear_bwd<<<blocks_for((int64_t)rows * length), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)base, (const float*)g, (float*)dvol, rows, length, taps);
  return (int)cudaGetLastError();
}
