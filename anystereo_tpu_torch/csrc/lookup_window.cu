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
//   - the [L, R] backward (B4 and B5, `window_t_bwd`; the "classify"
//     training step's lookup gradient): a thread a row and 16 entries
//     reloaded and re-floored its row's bases for every 16 entries, and read
//     up to two cotangent values a level and entry, 144 bytes apart between
//     neighbouring threads in layout 0, so every warp load touched 32
//     sectors: 18.2 us at the RAFT training shape against a bound of 0.92 on
//     the H100, bound by latency and scattered loads, not bytes.  So a block
//     of kBwdWarps warps owns a tile of kBwdRows rows (one 128-byte line of a
//     dvol_t row; lane = row) and a range of L.  It copies the tile's
//     cotangent (layout 0: nrows*levels*taps contiguous floats; layout 1:
//     levels*taps runs of nrows) and bases into shared memory by cp.async,
//     every copy in flight at once (one round trip), the cotangent
//     transposed to [channel][row] with an odd row stride so that neither
//     the copies nor the reads conflict on banks.  Each (row, level) forms
//     its window start once and its taps+1 slot coefficients once, already
//     scaled, into a table [level][slot][row] whose slot taps+1 and whose
//     dead cells (outside [0, L >> lvl)) hold zero, so an entry's lookup is
//     one clamp of cell - i0 and no branch.  Each warp then walks chunks of
//     max(2^(levels-1), 4) entries: a level's coefficient is read once a
//     cell and added into each of its entries, levels ascending, and each
//     entry stored as one 128-byte line of 32 rows; a chunk that no row's
//     window reaches at any level is stored as zeros without the lookups.
//     The walk is unrolled at compile time (`static_for`): a loop the
//     compiler left rolled put the chunk's sums in local memory and took
//     2.3x longer at 4 levels.  Where the tiles give the card's SMs fewer
//     than kBwdBlocksPerSM blocks each (6,400 rows at training), L is split
//     over grid.y, each range at least one chunk a warp, and a block forms
//     only the coefficients of the cells its range falls in (8 blocks an SM
//     lost at 29,952 rows, 8 warps a block at 239,616; `PERF.md` §6).
//     Tables over 227 KB (levels*taps beyond ~890) take the walk of a thread
//     a row (`window_t_bwd_walk`);
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
constexpr int kChunk = 16;  // entries of L a thread writes in the wide [L, R] backward
constexpr int kPmRows = 32;   // rows of a tile of the pixel-major forward
constexpr int kPmSpan = 128;  // the most entries of L it stages at a time (16 KB)
constexpr int kMaxShared = 227 * 1024;  // a block's most on Hopper
constexpr int kBwdRows = 32;     // rows of a tile of the [L, R] backward: lane = row
constexpr int kBwdStride = kBwdRows + 1;  // its staged cotangent's row stride (odd)
constexpr int kBwdWarps = 4;     // warps of its block
constexpr int kBwdBlocksPerSM = 4;  // blocks its split of L over grid.y gives each SM at least
static_assert(kPmRows % 32 == 0, "a warp of the pixel-major forward is rows of one level");
static_assert(kBwdRows == 32, "a lane of the [L, R] backward is a row of its tile");

// Shared memory of the [L, R] backward in 4-byte words: the tile's
// cotangent [levels*taps][kBwdStride], its slot coefficients
// [levels][taps + 2][kBwdRows] (slot taps + 1 a zero), and each (level,
// row)'s i0 and f.  64-bit: a window too wide for it takes the walk.
__host__ __device__ constexpr int64_t t_bwd_words(int levels, int64_t taps) {
  return levels * taps * kBwdStride + levels * (taps + 2) * kBwdRows + 2 * levels * kBwdRows;
}

// Entries a warp of the [L, R] backward walks at a time: one deepest cell,
// at least 4.
__host__ __device__ constexpr int t_bwd_chunk(int levels) {
  return (1 << (levels - 1)) > 4 ? 1 << (levels - 1) : 4;
}

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

// A loop index known at compile time, usable on the device.
template <int I>
struct Index {
  static constexpr int value = I;
  __host__ __device__ constexpr operator int() const { return I; }
};

// f(Index<i>{}) for i = 0 .. N-1, unrolled whatever the compiler's
// heuristics: arrays indexed by i stay in registers.
template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (N > 0) {
    static_for<N - 1>(f);
    f(Index<N - 1>{});
  }
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

// grid (tiles of kBwdRows rows, ranges of `span` entries of L), kBwdWarps
// warps; `span` a multiple of t_bwd_chunk(LEVELS).  Copies the tile's
// cotangent (`pixel_major`: layout 0) and bases into shared memory, forms
// the window starts and the slot coefficients of the cells the range falls
// in, then each warp walks chunks of entries, lane = row.
template <int LEVELS>
__global__ void __launch_bounds__(32 * kBwdWarps)
window_t_bwd(const float* __restrict__ bases_t, const float* __restrict__ g,
             float* __restrict__ dvol_t, int64_t rows, int length, int taps,
             int pixel_major, int span) {
  constexpr int chunk = t_bwd_chunk(LEVELS);
  extern __shared__ __align__(16) float smem[];
  const int chans = LEVELS * taps, slots = taps + 2;
  float* gs = smem;                                               // [chans][kBwdStride]
  float* coef = gs + chans * kBwdStride;                          // [LEVELS][slots][kBwdRows]
  int* s_i0 = reinterpret_cast<int*>(coef + LEVELS * slots * kBwdRows);  // [LEVELS][kBwdRows]
  float* s_f = reinterpret_cast<float*>(s_i0 + LEVELS * kBwdRows);       // [LEVELS][kBwdRows]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t r0 = (int64_t)blockIdx.x * kBwdRows;
  const int nrows = rows - r0 < kBwdRows ? (int)(rows - r0) : kBwdRows;
  // one round trip: every copy of the tile's cotangent (transposed into
  // gs[channel][row]) and of its bases (into s_f, as raw bases) in flight
  const uint64_t policy = evict_first();
  if (pixel_major) {  // the tile's rows, contiguous: element i is (i / chans, i % chans)
    const float* src = g + r0 * chans;
    for (int i = threadIdx.x; i < nrows * chans; i += blockDim.x) {
      const int row = i / chans;
      copy_async4(gs + (i - row * chans) * kBwdStride + row, src + i, policy);
    }
  } else {  // a run of the tile's rows a channel, zeros past its end
    for (int i = threadIdx.x; i < chans * kBwdRows; i += blockDim.x) {
      const int k = i / kBwdRows, row = i % kBwdRows;
      if (row < nrows)
        copy_async4(gs + k * kBwdStride + row, g + (int64_t)k * rows + r0 + row, policy);
      else
        gs[k * kBwdStride + row] = 0.0f;
    }
  }
  for (int t = threadIdx.x; t < LEVELS * kBwdRows; t += blockDim.x)
    if (t % kBwdRows < nrows)
      copy_async4(s_f + t, bases_t + (int64_t)(t / kBwdRows) * rows + r0 + t % kBwdRows, policy);
  copy_async_wait();
  // each (level, row)'s window start, from the base this thread copied; a
  // row past the tile's end has none
  for (int t = threadIdx.x; t < LEVELS * kBwdRows; t += blockDim.x) {
    const int n_lvl = length >> (t / kBwdRows);
    int i0 = n_lvl;
    float f = 0.0f;
    if (t % kBwdRows < nrows) window_start(s_f[t], n_lvl, taps, i0, f);
    s_i0[t] = i0;
    s_f[t] = f;
  }
  __syncthreads();
  const int e0 = blockIdx.y * span;
  const int e1 = min(e0 + span, length);
  // slot m of (row, level) is cell i0 + m: its coefficient
  // ((1 - f)*g_m + f*g_{m-1}) * 2^-lvl, zero for a cell outside [0, n_lvl)
  // and for slot taps + 1; a cell that no entry of the range falls in is
  // not formed (no stored entry looks it up)
#pragma unroll
  for (int lvl = 0; lvl < LEVELS; ++lvl) {
    const int n_lvl = length >> lvl;
    const int i0 = s_i0[lvl * kBwdRows + lane];
    const float f = s_f[lvl * kBwdRows + lane];
    const float omf = __fsub_rn(1.0f, f);
    const int clo = e0 >> lvl, chi = (e1 - 1) >> lvl;
    const float* gr = gs + lvl * taps * kBwdStride + lane;
    float* cr = coef + lvl * slots * kBwdRows + lane;
    for (int m = warp; m < slots; m += kBwdWarps) {
      const int cell = i0 + m;
      if (m > taps || cell < 0 || cell >= n_lvl) {
        cr[m * kBwdRows] = 0.0f;
      } else if (cell >= clo && cell <= chi) {
        float c = 0.0f;
        if (m < taps) c = __fmul_rn(omf, gr[m * kBwdStride]);
        if (m >= 1) c = __fadd_rn(c, __fmul_rn(f, gr[(m - 1) * kBwdStride]));
        cr[m * kBwdRows] = __fmul_rn(c, 1.0f / (float)(1 << lvl));
      }
    }
  }
  __syncthreads();
  // the entries [lo, hi) of the cells some row's window holds at some
  // level: a chunk outside them is zeros
  int i0r[LEVELS];
  int a = INT_MAX, b = INT_MIN;
#pragma unroll
  for (int lvl = 0; lvl < LEVELS; ++lvl) {
    i0r[lvl] = s_i0[lvl * kBwdRows + lane];
    const int c0 = max(i0r[lvl], 0), c1 = min(i0r[lvl] + taps + 1, length >> lvl);
    if (c0 < c1) a = min(a, c0 << lvl), b = max(b, c1 << lvl);
  }
  const int lo = __reduce_min_sync(0xffffffffu, a), hi = __reduce_max_sync(0xffffffffu, b);
  const bool store = lane < nrows;
  // a cell's coefficient is read once (slot taps + 1 where the cell lies
  // outside the row's window; a dead cell's slot holds zero) and added into
  // each of its entries, levels ascending
  for (int jc = e0 + warp * chunk; jc < e1; jc += kBwdWarps * chunk) {
    float acc[chunk];
    static_for<chunk>([&](auto t) { acc[t] = 0.0f; });
    if (jc < hi && jc + chunk > lo) {
      static_for<LEVELS>([&](auto lvl) {
        constexpr int width = 1 << decltype(lvl)::value;
        const float* cr = coef + lvl * slots * kBwdRows + lane;
        static_for<chunk / width>([&](auto q) {
          const int cell = (jc >> lvl) + q;
          const unsigned m = min((unsigned)(cell - i0r[lvl]), (unsigned)(taps + 1));
          const float c = cr[m * kBwdRows];
          static_for<width>([&](auto t) {
            acc[q * width + t] = __fadd_rn(acc[q * width + t], c);
          });
        });
      });
    }
    float* dst = dvol_t + (int64_t)jc * rows + r0 + lane;
    static_for<chunk>([&](auto t) {
      if (store && jc + t < e1) dst[(int64_t)t * rows] = acc[t];
    });
  }
}

// Windows whose coefficient table does not fit a block (levels*taps beyond
// ~890, wider than any model's): a thread a row and kChunk entries, each
// entry's slots found from the row's starts and its cotangent read from
// device memory.  (Its name holds `window_t_bwd`: a profiler sum by name
// takes both.)
__global__ void __launch_bounds__(kThreads)
window_t_bwd_walk(const float* __restrict__ bases_t, const float* __restrict__ g,
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

// Entries of L a block of the [L, R] backward covers: all of L, or, where
// its tiles give the card's `sms` SMs fewer than kBwdBlocksPerSM blocks
// each, L split into equal ranges, each a whole number of chunks and at
// least one chunk a warp.
inline int t_bwd_span(int64_t rows, int length, int chunk, int sms) {
  const int64_t tiles = (rows + kBwdRows - 1) / kBwdRows;
  const int64_t wanted = ((int64_t)kBwdBlocksPerSM * sms + tiles - 1) / tiles;
  const int most = (length + kBwdWarps * chunk - 1) / (kBwdWarps * chunk);
  const int ranges = (int)(wanted < most ? wanted : most);
  const int span = (length + ranges - 1) / ranges;
  return (span + chunk - 1) / chunk * chunk;
}

template <int LEVELS>
cudaError_t launch_t_bwd(const float* bases_t, const float* g, float* dvol_t, int64_t rows,
                         int length, int taps, int pixel_major, int sms, cudaStream_t s) {
  auto kernel = window_t_bwd<LEVELS>;
  const int shared = (int)(4 * t_bwd_words(LEVELS, taps));
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return err;
  }
  const int span = t_bwd_span(rows, length, t_bwd_chunk(LEVELS), sms);
  const dim3 grid((unsigned)((rows + kBwdRows - 1) / kBwdRows), (unsigned)((length + span - 1) / span));
  kernel<<<grid, 32 * kBwdWarps, shared, s>>>(bases_t, g, dvol_t, rows, length, taps, pixel_major, span);
  return cudaSuccess;
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
  } else if (4 * t_bwd_words(levels, taps) > kMaxShared) {
    const dim3 grid((unsigned)((rows + kThreads - 1) / kThreads),
                    (unsigned)((length + kChunk - 1) / kChunk));
    window_t_bwd_walk<<<grid, kThreads, 0, s>>>((const float*)bases, (const float*)g,
                                                (float*)dvol, rows, length, taps, levels,
                                                layout == 0);
  } else {
    int device, sms;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const int pm = layout == 0;
    const float *b = (const float*)bases, *gg = (const float*)g;
    float* d = (float*)dvol;
    switch (levels) {
      case 1: err = launch_t_bwd<1>(b, gg, d, rows, length, taps, pm, sms, s); break;
      case 2: err = launch_t_bwd<2>(b, gg, d, rows, length, taps, pm, sms, s); break;
      case 3: err = launch_t_bwd<3>(b, gg, d, rows, length, taps, pm, sms, s); break;
      case 4: err = launch_t_bwd<4>(b, gg, d, rows, length, taps, pm, sms, s); break;
      default: err = launch_t_bwd<5>(b, gg, d, rows, length, taps, pm, sms, s); break;
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
