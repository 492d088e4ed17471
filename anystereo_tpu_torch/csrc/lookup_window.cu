// Multi-level windowed tap lookup from per-level window starts, for Hopper
// (sm_90a), in the three layouts of the JAX package's window-pyramid kernels.
//
// Replaces the TPU kernels of anystereo_tpu/ops/pallas/lookup_kernel.py:
//   layout 0  `gather_pyramid_window_pm`  vol_t [L, R], bases_t [levels, R]
//             -> out [R, levels*taps]        (bodies `_pyr_t_fwd_kernel`,
//             `_pyr_t_bwd_kernel`, pixel_major=True)
//   layout 1  `gather_pyramid_window_t`   same inputs -> out [levels*taps, R]
//             (same bodies, pixel_major=False)
//   layout 2  `gather_pyramid_window`     vol [R, L], bases [R, levels]
//             -> out [R, levels*taps]        (`_pyr_fwd_kernel`,
//             `_pyr_bwd_kernel`)
//
// What they compute.  Row r has, per level lvl, a window start base (in that
// level's pooled units; NOT clamped).  i0 = floor(base) and f = base - i0 are
// shared by all taps of the level.  The level reads the row pooled by 2^lvl:
// s_m = pooled[i0 + m] for m = 0..taps, zero outside [0, L >> lvl), where
// pooled[c] = (sum of the 2^lvl entries c*2^lvl ...) * 2^-lvl; the tail
// j >= (L >> lvl) << lvl is never read.  out_k = (1 - f)*s_k + f*s_{k+1},
// level-major tap blocks, fp32.  The backward is the transpose in the volume:
// entry j gets, from each level with j inside the pooled range, the slot
// coefficient c_m = ((1 - f)*g_m + f*g_{m-1}) * 2^-lvl of its slot
// m = (j >> lvl) - i0 (terms with a tap index outside [0, taps) absent).
//
// What bounds them: memory.  A tap is ~4 flops over a few loaded values.  The
// TPU bodies classify every (entry, pixel) pair into a tap slot with masked
// selects, in blocks of 8 sublanes, because pixels sit on its lanes; here
// only the entries inside some window are read, and a row the positions
// never reach is never read.  The tap arithmetic is shared; the layouts
// differ in addressing and thread mapping:
//   - layout 0 (B4, the "classify" flavor's lookup; `window_pm_fwd`): an
//     [L, R] volume keeps one entry of neighbouring rows side by side, so a
//     thread that walks its own row's window (one 4-byte load at a stride
//     of R floats per entry, 2^lvl sectors a cell) shares a sector with its
//     neighbours only where their windows happen to coincide: 46.9-50.2 us
//     at the eval shapes against bounds of 11.3-19.0 (H100, `PERF.md` §6).
//     So a block owns a tile of kPmRows consecutive rows (a whole 128-byte
//     line of a volume row) and one thread a (row, level) pair.  The pairs'
//     windows give each row the entries it needs and the tile the span
//     [lo, hi) over all its rows and levels (lo rounded down to the deepest
//     cell width, so that no cell straddles two chunks).  The span goes
//     through shared memory a chunk at a time (the row rounded up to 16
//     entries, at most kPmSpan): vol_t[j0 : j0 + chunk, r0 : r0 + kPmRows]
//     arrives by cp.async, 16 bytes (4 rows) a copy where R % 4 == 0 and 4
//     bytes a row where not, and only the copies that some row of the 4
//     needs are made; after a chunk the walk goes on at the first entry a
//     row still needs (rounded down), so a stretch that no row needs is
//     skipped.  A tile whose rows' windows lie far apart (random positions,
//     or the correlation tile that wraps to the next image row) thus reads
//     about what its windows need and not the whole span.  Each pair forms,
//     in ascending order, the pooled cells that lie in the chunk and the
//     taps they complete; a window that spans several chunks carries its
//     last cell over.  Along a tile the main path's positions are smooth
//     (the GEV volume's 8 groups of a pixel share one x; the correlation's
//     x = column - d), so there the span is one chunk of about one window.
//     The tile's taps, levels*taps floats a row, lie contiguous in `out`:
//     they are collected in shared memory and written as 16-byte vectors.
//     The volume's loads carry an evict-first L2 hint, as the aligned
//     lookup's do (the GRU loop's two volumes are larger than L2).  The GEV
//     call is then bound by bytes (its fp32 taps alone are 17 MB); 32-row
//     tiles, 128-entry chunks and the hint each won in the eval paths on
//     the H100 (`PERF.md` §6);
//   - layout 1 (B5, `window_t_fwd`): adjacent threads take adjacent r of one
//     level and walk their windows; the loads of bases_t and the stores to
//     the transposed out coalesce along R;
//   - the [L, R] backward (B4 and B5) splits L over grid.y as well, each
//     thread writing kChunk entries of its column, so that the stores to
//     dvol_t coalesce and the grid fills the card;
//   - [R, L] volumes (layout 2, B6): a thread per (row, level) forward, a
//     warp per row backward with lanes striding over L (coalesced stores).
// The backward finds an entry's slot by index arithmetic (one subtraction a
// level) and forms only that slot's coefficient: no loop over taps per entry,
// no atomics, and every entry of dvol is written (zeros included), so the
// wrapper hands in uninitialised memory.
//
// Numerics: every operation is an explicit round-to-nearest intrinsic in the
// order of the plain PyTorch versions (`ops/kernels/lookup_window.py`): the
// 2^lvl entries of a cell summed in ascending order, then scaled; taps as
// (1-f)*s_k + f*s_{k+1}; the gradient's levels summed in ascending order.
// nvcc may contract nothing into an FMA, so kernel and plain version agree
// bit for bit.  floor(base) is clamped in float to [-(taps+1), L >> lvl]
// before the conversion to int: that moves only windows with no live tap and
// keeps i0 + m from overflowing for positions like 3e9.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "async_copy.cuh"

namespace {

constexpr int kMaxLevels = 5;  // a cell sums at most 2^4 entries
constexpr int kThreads = 256;
constexpr int kChunk = 16;  // entries of L a thread writes in the [L, R] backward
constexpr int kPmRows = 32;   // rows of a tile of the pixel-major forward
constexpr int kPmSpan = 128;  // the most entries of L it stages at a time (16 KB)
constexpr int kMaxShared = 227 * 1024;  // a block's most on Hopper
static_assert(kPmRows % 32 == 0, "a warp of the pixel-major forward is rows of one level");

// Entries of L the pixel-major forward stages at a time: the row rounded up
// to 16 entries (the widest cell), at most kPmSpan.
__host__ __device__ constexpr int pm_chunk(int length) {
  return (length + 15) / 16 * 16 < kPmSpan ? (length + 15) / 16 * 16 : kPmSpan;
}

// Shared memory of the pixel-major forward: the staged chunk
// [chunk][kPmRows], the tile's taps [kPmRows][levels*taps], each row's
// entry hull (first, end), the tile's span (lo, hi) and the next chunk's
// start (two slots), all 4-byte words.
__host__ __device__ constexpr int pm_shared_bytes(int chunk, int levels, int taps) {
  return 4 * (chunk * kPmRows + kPmRows * levels * taps + 2 * kPmRows + 4);
}

// i0 (clamped, as an int) and the fractional weight of a level's window.
__device__ __forceinline__ void window_start(float base, int n_lvl, int taps,
                                             int& i0, float& f) {
  const float f0 = floorf(base);
  f = __fsub_rn(base, f0);
  i0 = (int)fminf(fmaxf(f0, -(float)(taps + 1)), (float)n_lvl);
}

// Pooled cell c of a row at level lvl: ascending sum of its 2^lvl entries,
// then the scale.  `stride` is the distance between consecutive entries.
__device__ __forceinline__ float pooled_cell(const float* __restrict__ row,
                                             int64_t stride, int c, int lvl,
                                             int n_lvl) {
  if (c < 0 || c >= n_lvl) return 0.0f;
  const int width = 1 << lvl;
  const float* p = row + (int64_t)c * width * stride;
  float s = __ldg(p);
  for (int t = 1; t < width; ++t) s = __fadd_rn(s, __ldg(p + t * stride));
  return __fmul_rn(s, 1.0f / (float)width);
}

// One (row, level): taps outputs, `out_step` apart.
__device__ __forceinline__ void level_taps(const float* __restrict__ row,
                                           int64_t vol_step, float base,
                                           int length, int taps, int lvl,
                                           float* __restrict__ out,
                                           int64_t out_step) {
  const int n_lvl = length >> lvl;
  int i0;
  float f;
  window_start(base, n_lvl, taps, i0, f);
  const float omf = __fsub_rn(1.0f, f);
  float prev = pooled_cell(row, vol_step, i0, lvl, n_lvl);
  for (int k = 0; k < taps; ++k) {
    const float cur = pooled_cell(row, vol_step, i0 + k + 1, lvl, n_lvl);
    out[k * out_step] = __fadd_rn(__fmul_rn(omf, prev), __fmul_rn(f, cur));
    prev = cur;
  }
}

// Gradient of entry j of a row: per level, the coefficient of the slot the
// entry's cell falls in.  g(c) is the row's cotangent channel c at g[c*g_step].
__device__ __forceinline__ float entry_grad(int j, int length, int taps, int levels,
                                            const int* i0, const float* f,
                                            const float* __restrict__ g,
                                            int64_t g_step) {
  float acc = 0.0f;
#pragma unroll
  for (int lvl = 0; lvl < kMaxLevels; ++lvl) {
    if (lvl >= levels) break;
    const int n_lvl = length >> lvl;
    if (j >= (n_lvl << lvl)) continue;
    const int m = (j >> lvl) - i0[lvl];
    if (m < 0 || m > taps) continue;
    float c = 0.0f;
    if (m < taps)
      c = __fmul_rn(__fsub_rn(1.0f, f[lvl]), __ldg(g + (int64_t)(lvl * taps + m) * g_step));
    if (m >= 1)
      c = __fadd_rn(c, __fmul_rn(f[lvl], __ldg(g + (int64_t)(lvl * taps + m - 1) * g_step)));
    acc = __fadd_rn(acc, __fmul_rn(c, 1.0f / (float)(1 << lvl)));
  }
  return acc;
}

// ---- [L, R] volumes: layouts 0 (pixel-major out) and 1 (transposed out) ----

__global__ void __launch_bounds__(kThreads)
window_t_fwd(const float* __restrict__ vol_t, const float* __restrict__ bases_t,
             float* __restrict__ out, int64_t rows, int length, int taps,
             int levels) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * levels) return;
  const int lvl = (int)(t / rows);  // adjacent threads: adjacent r, same level
  const int64_t r = t - (int64_t)lvl * rows;
  level_taps(vol_t + r, rows, __ldg(bases_t + (int64_t)lvl * rows + r), length,
             taps, lvl, out + (int64_t)(lvl * taps) * rows + r, rows);
}

// blockDim = kPmRows * levels: thread t takes row t % kPmRows of the tile
// at level t / kPmRows, so a warp is the tile's rows at one level.
// `chunk` = pm_chunk(length); `vec`: R % 4 == 0 and vol_t on a 16-byte
// boundary (16-byte copies).
__global__ void window_pm_fwd(const float* __restrict__ vol_t,
                              const float* __restrict__ bases_t,
                              float* __restrict__ out, int64_t rows, int length,
                              int taps, int levels, int chunk, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int chans = levels * taps;
  float* span = smem;                              // [chunk][kPmRows]
  float* stage = span + chunk * kPmRows;           // [kPmRows][chans]
  int* first = reinterpret_cast<int*>(stage + kPmRows * chans);  // [kPmRows]
  int* end = first + kPmRows;                      // [kPmRows]
  int* tile_span = end + kPmRows;                  // lo, hi
  int* next = tile_span + 2;                       // the next chunk's start, by parity
  const int row = threadIdx.x % kPmRows;
  const int lvl = threadIdx.x / kPmRows;
  const int64_t r0 = (int64_t)blockIdx.x * kPmRows;
  const int nrows = rows - r0 < kPmRows ? (int)(rows - r0) : kPmRows;
  const int width = 1 << lvl;
  const int n_lvl = length >> lvl;
  // the pair's window: its live cells [c0, c1) are the entries [a, b)
  int i0 = 0;
  float f = 0.0f;
  int a = INT_MAX, b = INT_MIN;
  if (row < nrows) {
    window_start(__ldg(bases_t + (int64_t)lvl * rows + r0 + row), n_lvl, taps, i0, f);
    const int c0 = max(i0, 0), c1 = min(i0 + taps + 1, n_lvl);
    if (c0 < c1) a = c0 * width, b = c1 * width;
  }
  if (lvl == 0) first[row] = INT_MAX, end[row] = INT_MIN;
  if (threadIdx.x == 0) tile_span[0] = INT_MAX, tile_span[1] = INT_MIN, next[0] = INT_MAX;
  __syncthreads();
  if (a < b) atomicMin(first + row, a), atomicMax(end + row, b);
  const int wa = __reduce_min_sync(0xffffffffu, a), wb = __reduce_max_sync(0xffffffffu, b);
  if (threadIdx.x % 32 == 0 && wa < wb) atomicMin(tile_span, wa), atomicMax(tile_span + 1, wb);
  __syncthreads();
  // an empty tile has lo = INT_MAX rounded down > hi = INT_MIN: no chunk.
  // Chunks start on multiples of the deepest cell width, so no cell
  // straddles two; after a chunk the walk goes on at the first entry that a
  // row still needs (rounded down), so a stretch no row needs is skipped.
  const int top = 1 << (levels - 1);
  const int lo = tile_span[0] & -top, hi = tile_span[1];
  const uint64_t policy = evict_first();
  const float omf = __fsub_rn(1.0f, f);
  float* o = stage + row * chans + lvl * taps;
  float prev = 0.0f;
  int m = 0;  // the next of the window's taps+1 cells
  for (int j0 = lo, k = 0; j0 < hi; ++k) {
    const int n = min(chunk, hi - j0);
    for (int v = threadIdx.x; v < n * (kPmRows / 4); v += blockDim.x) {
      const int jj = v / (kPmRows / 4), q = 4 * (v % (kPmRows / 4));
      const int j = j0 + jj;
      const int4 qa = *reinterpret_cast<const int4*>(first + q);
      const int4 qb = *reinterpret_cast<const int4*>(end + q);
      const bool n0 = qa.x <= j && j < qb.x, n1 = qa.y <= j && j < qb.y,
                 n2 = qa.z <= j && j < qb.z, n3 = qa.w <= j && j < qb.w;
      const float* src = vol_t + (int64_t)j * rows + r0 + q;
      float* dst = span + jj * kPmRows + q;
      if (vec && q + 4 <= nrows) {
        if (n0 || n1 || n2 || n3) copy_async16(dst, src, policy);
      } else {  // a row that needs the entry is a row of the tile
        if (n0) copy_async4(dst, src, policy);
        if (n1) copy_async4(dst + 1, src + 1, policy);
        if (n2) copy_async4(dst + 2, src + 2, policy);
        if (n3) copy_async4(dst + 3, src + 3, policy);
      }
    }
    if (threadIdx.x < kPmRows) {  // the first entry from j0 + n on that a row needs
      const int j1 = j0 + n;
      const int want = __reduce_min_sync(0xffffffffu, end[row] > j1 ? max(first[row], j1) : INT_MAX);
      if (threadIdx.x % 32 == 0) atomicMin(next + (k & 1), want);
    }
    if (threadIdx.x == 0) next[(k + 1) & 1] = INT_MAX;  // last read before the previous chunk's end
    copy_async_wait();
    __syncthreads();
    // the pair's cells that lie in this chunk, ascending; a cell below 0 is
    // zero and a cell from n_lvl on waits for the end
    for (; m <= taps && row < nrows; ++m) {
      const int c = i0 + m;
      float s = 0.0f;
      if (c >= 0) {
        const int e = c * width - j0;
        if (c >= n_lvl || e + width > n) break;
        const float* p = span + e * kPmRows + row;
        s = p[0];
        for (int t = 1; t < width; ++t) s = __fadd_rn(s, p[t * kPmRows]);
        s = __fmul_rn(s, 1.0f / (float)width);
      }
      if (m > 0) o[m - 1] = __fadd_rn(__fmul_rn(omf, prev), __fmul_rn(f, s));
      prev = s;
    }
    const int following = next[k & 1];
    j0 = following == INT_MAX ? hi : following & -top;
    __syncthreads();  // the chunk is read before the next one lands
  }
  // the cells past the last chunk are zero (outside [0, n_lvl), or the whole
  // window where it has no live cell)
  for (; m <= taps && row < nrows; ++m) {
    if (m > 0) o[m - 1] = __fadd_rn(__fmul_rn(omf, prev), __fmul_rn(f, 0.0f));
    prev = 0.0f;
  }
  __syncthreads();
  // the tile's taps are contiguous in `out`: 16-byte stores, then the tail
  const int total = nrows * chans;
  float* dst = out + r0 * chans;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    for (int i = threadIdx.x; i < total / 4; i += blockDim.x)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(stage)[i];
    done = total & ~3;
  }
  for (int i = done + threadIdx.x; i < total; i += blockDim.x) dst[i] = stage[i];
}

__global__ void __launch_bounds__(kThreads)
window_t_bwd(const float* __restrict__ bases_t, const float* __restrict__ g,
             float* __restrict__ dvol_t, int64_t rows, int length, int taps,
             int levels, int pixel_major) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  int i0[kMaxLevels];
  float f[kMaxLevels];
#pragma unroll
  for (int lvl = 0; lvl < kMaxLevels; ++lvl) {
    i0[lvl] = 0;
    f[lvl] = 0.0f;
    if (lvl < levels)
      window_start(__ldg(bases_t + (int64_t)lvl * rows + r), length >> lvl, taps,
                   i0[lvl], f[lvl]);
  }
  const float* grow = pixel_major ? g + r * (int64_t)(levels * taps) : g + r;
  const int64_t g_step = pixel_major ? 1 : rows;
  const int j0 = blockIdx.y * kChunk;
  const int j1 = min(j0 + kChunk, length);
  for (int j = j0; j < j1; ++j)
    dvol_t[(int64_t)j * rows + r] = entry_grad(j, length, taps, levels, i0, f, grow, g_step);
}

// ---- [R, L] volumes: layout 2 ----

__global__ void __launch_bounds__(kThreads)
window_rows_fwd(const float* __restrict__ vol, const float* __restrict__ bases,
                float* __restrict__ out, int64_t rows, int length, int taps,
                int levels) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * levels) return;
  const int64_t r = t / levels;
  const int lvl = (int)(t - r * levels);
  level_taps(vol + r * length, 1, __ldg(bases + t), length, taps, lvl,
             out + r * (int64_t)(levels * taps) + lvl * taps, 1);
}

__global__ void __launch_bounds__(kThreads)
window_rows_bwd(const float* __restrict__ bases, const float* __restrict__ g,
                float* __restrict__ dvol, int64_t rows, int length, int taps,
                int levels) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;
  int i0[kMaxLevels];
  float f[kMaxLevels];
#pragma unroll
  for (int lvl = 0; lvl < kMaxLevels; ++lvl) {
    i0[lvl] = 0;
    f[lvl] = 0.0f;
    if (lvl < levels)
      window_start(__ldg(bases + r * levels + lvl), length >> lvl, taps, i0[lvl], f[lvl]);
  }
  const float* grow = g + r * (int64_t)(levels * taps);
  float* drow = dvol + r * length;
  for (int j = lane; j < length; j += 32)
    drow[j] = entry_grad(j, length, taps, levels, i0, f, grow, 1);
}

}  // namespace

// Forward.  layout 0: vol [length, rows], bases [levels, rows], out
// [rows, levels*taps]; layout 1: same inputs, out [levels*taps, rows]; layout
// 2: vol [rows, length], bases [rows, levels], out [rows, levels*taps].  All
// fp32 and contiguous.  Launches on `stream`; returns cudaGetLastError().
extern "C" int anystereo_gather_pyramid_window(const void* vol, const void* bases,
                                               void* out, long long rows, int length,
                                               int taps, int levels, int layout,
                                               void* stream) {
  if (levels < 1 || levels > kMaxLevels || layout < 0 || layout > 2 || taps < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)rows * levels;
  if (n == 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (layout == 2) {
    window_rows_fwd<<<blocks, kThreads, 0, s>>>((const float*)vol, (const float*)bases,
                                                (float*)out, rows, length, taps, levels);
  } else if (layout == 1) {
    window_t_fwd<<<blocks, kThreads, 0, s>>>((const float*)vol, (const float*)bases,
                                             (float*)out, rows, length, taps, levels);
  } else {
    // 16-byte copies need every volume row (R floats) on a 16-byte boundary
    const int vec = rows % 4 == 0 && (reinterpret_cast<uintptr_t>(vol) & 15) == 0;
    const int chunk = pm_chunk(length);
    const int shared = taps <= kMaxShared / (4 * kPmRows * levels)
                           ? pm_shared_bytes(chunk, levels, taps) : kMaxShared + 1;
    // taps beyond 337 at 5 levels (rows of 128 entries or more) do not fit
    if (shared > kMaxShared) return (int)cudaErrorInvalidValue;
    if (shared > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          window_pm_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
      if (err != cudaSuccess) return (int)err;
    }
    window_pm_fwd<<<(unsigned)((rows + kPmRows - 1) / kPmRows), kPmRows * levels, shared, s>>>(
        (const float*)vol, (const float*)bases, (float*)out, rows, length, taps, levels, chunk, vec);
  }
  return (int)cudaGetLastError();
}

// Backward in the volume.  g has the forward's output layout, dvol the
// volume's; every entry of dvol is written.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int anystereo_gather_pyramid_window_bwd(const void* bases, const void* g,
                                                   void* dvol, long long rows,
                                                   int length, int taps, int levels,
                                                   int layout, void* stream) {
  if (levels < 1 || levels > kMaxLevels || layout < 0 || layout > 2 || taps < 1)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || length == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (layout == 2) {
    const int rows_per_block = kThreads / 32;
    const unsigned blocks = (unsigned)((rows + rows_per_block - 1) / rows_per_block);
    window_rows_bwd<<<blocks, kThreads, 0, s>>>((const float*)bases, (const float*)g,
                                                (float*)dvol, rows, length, taps, levels);
  } else {
    const dim3 grid((unsigned)((rows + kThreads - 1) / kThreads),
                    (unsigned)((length + kChunk - 1) / kChunk));
    window_t_bwd<<<grid, kThreads, 0, s>>>((const float*)bases, (const float*)g,
                                           (float*)dvol, rows, length, taps, levels,
                                           layout == 0);
  }
  return (int)cudaGetLastError();
}
