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
// moved.  The TPU kernel's barrel rolls and masked selects existed to put
// pixels on the VPU's lanes; here each thread owns one (row, level) pair
// and reads only that row's window: taps+1 pooled values, i.e. at most
// (taps+1)*2^lvl consecutive floats, from device memory once (repeated
// reads of the window hit L1).  Pooling happens in registers.  A volume row
// that the positions never touch is never read, which is what keeps the
// all-pairs correlation call (L = W/4 = 312) far below a full read of its
// 37 MB volume.  Rows are independent, so there is no shared memory and no
// synchronisation; making the loads wider and coalesced is later work.
//
// Numerics match the plain PyTorch version (`gather_pyramid_aligned_ref`)
// operation for operation: tap positions are base + k in fp32, pooling is
// the pairwise mean-of-means of repeated halving, and the interpolation is
// v0*(1-w) + v1*w with explicit round-to-nearest intrinsics so that nvcc
// contracts nothing into an FMA.
//
// Backward (`anystereo_gather_pyramid_aligned_bwd`, replaces
// `_pyr_align_bwd_kernel` of the same file): the transpose of the above in
// `vol`.  Row r of `dvol [R, L]` depends on that row's g[r, :] and x[r]
// only, so there is no race and no atomic: one warp owns a row and its
// lanes stride over the L entries, which makes the writes coalesced.  For
// entry j and level lvl (only while j < (L >> lvl) << lvl: the odd tail is
// never pooled and gets zero) the pooled cell is c = j >> lvl; every tap k
// whose lower cell floor(base + k) is c adds g*(1 - w_k), every tap whose
// upper cell is c adds g*w_k, and the level's sum is scaled by 2^-lvl (the
// gradient of the mean of means).  A cell index that equals c is inside
// [0, (L >> lvl) - 1] by construction, which is the forward's validity
// test.  Every entry of dvol is written, zeros included, so the wrapper
// hands in uninitialised memory.  `g` arrives in the forward's output type
// (bf16 on the training path) and is widened to fp32 at the load.  Bound:
// bytes (g and x read, the whole of dvol written once).  The tap positions,
// weights and the order of the sums (taps ascending, lower cell before
// upper, levels ascending) repeat `gather_pyramid_aligned_bwd_ref`, so the
// two agree exactly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kMaxWidth = 16;  // 2^(levels-1) <= 16, so levels <= 5
constexpr int kThreads = 256;

// Pooled value j of a row at width 2^lvl: pairwise mean of means, the same
// rounding as halving the row lvl times.  Zero outside [0, n_lvl).
__device__ __forceinline__ float pooled(const float* __restrict__ row, int j,
                                        int width, int n_lvl) {
  if (j < 0 || j >= n_lvl) return 0.0f;
  const float* p = row + (int64_t)j * width;
  float buf[kMaxWidth];
#pragma unroll
  for (int m = 0; m < kMaxWidth; ++m) buf[m] = (m < width) ? __ldg(p + m) : 0.0f;
#pragma unroll
  for (int s = 1; s < kMaxWidth; s <<= 1) {
#pragma unroll
    for (int m = 0; m + s < kMaxWidth; m += 2 * s) {
      if (2 * s <= width) buf[m] = __fmul_rn(__fadd_rn(buf[m], buf[m + s]), 0.5f);
    }
  }
  return buf[0];
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
pyr_aligned_fwd(const float* __restrict__ vol, const float* __restrict__ x,
                OutT* __restrict__ out, int64_t rows, int length, int taps,
                int levels, float lo, float hi) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * levels) return;
  const int64_t r = t / levels;
  const int lvl = (int)(t - r * levels);
  const float* row = vol + r * length;
  const int radius = (taps - 1) / 2;
  const int width = 1 << lvl;
  const int n_lvl = length >> lvl;
  const float xc = fminf(fmaxf(__ldg(x + r), lo), hi);
  // the scale is a power of two, so the product is exact
  const float base = __fsub_rn(__fmul_rn(xc, 1.0f / (float)width), (float)radius);
  OutT* o = out + r * (int64_t)(levels * taps) + lvl * taps;
  int cached_i = INT_MIN;
  float cached_v = 0.0f;
  for (int k = 0; k < taps; ++k) {
    const float pos = __fadd_rn(base, (float)k);
    const float f0 = floorf(pos);
    const float w1 = __fsub_rn(pos, f0);
    const int i0 = (int)f0;
    const float v0 = (i0 == cached_i) ? cached_v : pooled(row, i0, width, n_lvl);
    const float v1 = pooled(row, i0 + 1, width, n_lvl);
    cached_i = i0 + 1;
    cached_v = v1;
    store(o + k, __fadd_rn(__fmul_rn(v0, __fsub_rn(1.0f, w1)), __fmul_rn(v1, w1)));
  }
}

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename GT>
__global__ void __launch_bounds__(kThreads)
pyr_aligned_bwd(const float* __restrict__ x, const GT* __restrict__ g,
                float* __restrict__ dvol, int64_t rows, int length, int taps,
                int levels, float lo, float hi) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int radius = (taps - 1) / 2;
  const float xc = fminf(fmaxf(__ldg(x + r), lo), hi);
  const GT* grow = g + r * (int64_t)(levels * taps);
  float* drow = dvol + r * length;
  for (int j = lane; j < length; j += 32) {
    float acc = 0.0f;
    for (int lvl = 0; lvl < levels; ++lvl) {
      const int n_lvl = length >> lvl;
      if (j >= (n_lvl << lvl)) continue;
      const int c = j >> lvl;
      const float inv = 1.0f / (float)(1 << lvl);
      const float base = __fsub_rn(__fmul_rn(xc, inv), (float)radius);
      float s = 0.0f;
      for (int k = 0; k < taps; ++k) {
        const float pos = __fadd_rn(base, (float)k);
        const float f0 = floorf(pos);
        const int i0 = (int)f0;
        if (i0 != c && i0 + 1 != c) continue;
        const float w1 = __fsub_rn(pos, f0);
        const float gk = load_f32(grow + lvl * taps + k);
        if (i0 == c) s = __fadd_rn(s, __fmul_rn(gk, __fsub_rn(1.0f, w1)));
        if (i0 + 1 == c) s = __fadd_rn(s, __fmul_rn(gk, w1));
      }
      acc = __fadd_rn(acc, __fmul_rn(s, inv));
    }
    drow[j] = acc;
  }
}

}  // namespace

// vol [rows, length] fp32, x [rows] fp32, out [rows, levels*taps] fp32
// (out_bf16 == 0) or bf16.  Launches on `stream`; returns cudaGetLastError().
extern "C" int anystereo_gather_pyramid_aligned(const void* vol, const void* x,
                                                void* out, long long rows,
                                                int length, int taps, int levels,
                                                int out_bf16, void* stream) {
  const int radius = (taps - 1) / 2;
  const float slack = (float)((radius + 2) * (1 << levels));
  const float lo = -slack;
  const float hi = (float)length + slack;
  const int64_t n = (int64_t)rows * levels;
  if (n == 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (out_bf16) {
    pyr_aligned_fwd<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        (const float*)vol, (const float*)x, (__nv_bfloat16*)out, rows, length,
        taps, levels, lo, hi);
  } else {
    pyr_aligned_fwd<float><<<blocks, kThreads, 0, s>>>(
        (const float*)vol, (const float*)x, (float*)out, rows, length, taps,
        levels, lo, hi);
  }
  return (int)cudaGetLastError();
}

// x [rows] fp32, g [rows, levels*taps] fp32 (g_bf16 == 0) or bf16, dvol
// [rows, length] fp32, every entry written.  One warp per row.  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int anystereo_gather_pyramid_aligned_bwd(const void* x, const void* g,
                                                    void* dvol, long long rows,
                                                    int length, int taps,
                                                    int levels, int g_bf16,
                                                    void* stream) {
  const int radius = (taps - 1) / 2;
  const float slack = (float)((radius + 2) * (1 << levels));
  const float lo = -slack;
  const float hi = (float)length + slack;
  if (rows == 0 || length == 0) return (int)cudaGetLastError();
  const int rows_per_block = kThreads / 32;
  const unsigned blocks = (unsigned)((rows + rows_per_block - 1) / rows_per_block);
  cudaStream_t s = (cudaStream_t)stream;
  if (g_bf16) {
    pyr_aligned_bwd<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        (const float*)x, (const __nv_bfloat16*)g, (float*)dvol, rows, length,
        taps, levels, lo, hi);
  } else {
    pyr_aligned_bwd<float><<<blocks, kThreads, 0, s>>>(
        (const float*)x, (const float*)g, (float*)dvol, rows, length, taps,
        levels, lo, hi);
  }
  return (int)cudaGetLastError();
}
