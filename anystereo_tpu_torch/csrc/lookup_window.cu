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
// selects, in blocks of 8 sublanes, because pixels sit on its lanes; here a
// thread reads only its own window, at most (taps+1)*2^lvl entries a level,
// and a row the positions never reach is never read.  The tap arithmetic
// below is shared; the layouts differ in addressing and thread mapping:
//   - [L, R] volumes (layouts 0 and 1): adjacent threads take adjacent r, so
//     the loads of bases_t, the volume reads of rows with equal i0 and (for
//     layout 1) the stores coalesce along R.  Layout 0's output rows are
//     levels*taps floats apart, so a block of kPmRows rows x all levels
//     collects its taps in shared memory and then writes its contiguous
//     stretch of `out` with coalesced stores (written per thread, the
//     strided stores took more time than all the loads).  The backward
//     splits L over grid.y as well, each thread writing kChunk entries of
//     its column, so that the stores to dvol_t coalesce and the grid fills
//     the card;
//   - [R, L] volumes (layout 2): a thread per (row, level) forward, a warp
//     per row backward with lanes striding over L (coalesced stores).
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

namespace {

constexpr int kMaxLevels = 5;  // a cell sums at most 2^4 entries
constexpr int kThreads = 256;
constexpr int kChunk = 16;  // entries of L a thread writes in the [L, R] backward
constexpr int kPmRows = 64;  // rows a block of the pixel-major forward stages

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

// blockDim = (kPmRows, levels): threadIdx.x is the row within the block,
// threadIdx.y the level.  The tile has one padding float a row, so that the
// threads of a warp (a stride of a row apart) hit different banks.
__global__ void window_pm_fwd(const float* __restrict__ vol_t,
                              const float* __restrict__ bases_t,
                              float* __restrict__ out, int64_t rows, int length,
                              int taps, int levels) {
  extern __shared__ float tile[];  // [kPmRows][levels*taps + 1]
  const int chans = levels * taps;
  const int64_t r0 = (int64_t)blockIdx.x * kPmRows;
  const int lvl = threadIdx.y;
  const int64_t r = r0 + threadIdx.x;
  if (r < rows)
    level_taps(vol_t + r, rows, __ldg(bases_t + (int64_t)lvl * rows + r), length,
               taps, lvl, tile + threadIdx.x * (chans + 1) + lvl * taps, 1);
  __syncthreads();
  const int64_t left = rows - r0;
  const int n = (int)(left < kPmRows ? left : kPmRows) * chans;
  float* dst = out + r0 * chans;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < n; i += blockDim.x * blockDim.y) {
    const int row = i / chans;
    dst[i] = tile[row * (chans + 1) + (i - row * chans)];
  }
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
    const size_t smem = (size_t)kPmRows * (levels * taps + 1) * sizeof(float);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // taps beyond ~38 a level
    window_pm_fwd<<<(unsigned)((rows + kPmRows - 1) / kPmRows), dim3(kPmRows, levels), smem, s>>>(
        (const float*)vol, (const float*)bases, (float*)out, rows, length, taps, levels);
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
